"""backsub_retract_ms_per_iter.dubrovnik: device milliseconds an LM
iteration of a BAL solve of the work launched in ``slam:backsub`` and
``slam:lm.retract``, read as ``backsub_retract_ms_per_iter`` reads
them."""

from benchmark.harness import manifest

KINDS = ("closed_solves_bal",)
read = manifest.load_reader("backsub_retract_ms_per_iter").read
