"""sync_wait_ms_per_iter.dubrovnik: host milliseconds an LM iteration of a
BAL solve waits for the device (``slam:sync.*``), read as
``sync_wait_ms_per_iter`` reads them."""

from benchmark.harness import manifest

KINDS = ("closed_solves_bal",)
read = manifest.load_reader("sync_wait_ms_per_iter").read
