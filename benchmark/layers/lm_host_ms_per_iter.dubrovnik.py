"""lm_host_ms_per_iter.dubrovnik: host milliseconds an LM iteration of a
BAL solve takes to issue its work (``slam:lm.iter`` less its
``slam:sync.*``), read as ``lm_host_ms_per_iter`` reads them."""

from benchmark.harness import manifest

KINDS = ("closed_solves_bal",)
read = manifest.load_reader("lm_host_ms_per_iter").read
