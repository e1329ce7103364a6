"""launches_per_iter.dubrovnik: host calls that launch work on the device
(kernel and graph launches alike) per LM iteration of BAL solves, read as
``launches_per_iter`` reads them."""

from benchmark.harness import manifest

KINDS = ("closed_solves_bal",)
read = manifest.load_reader("launches_per_iter").read
