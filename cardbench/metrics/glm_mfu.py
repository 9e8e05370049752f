"""glm_mfu: the useful FLOPs of the GLM-4.7-Flash prefill rounds completed in
the traced span of the loop, rounds still in flight
(``cardbench/glm_roofline.py``), over the traced window times the card's
peak in the configuration's dtype, in %: ``model_mfu``'s reading of the
same record keys.  Nothing where the trace saw no device time."""

from pathlib import Path

from cardbench import harness


def read(record):
    here = Path(__file__).resolve().parents[1]
    return harness.module("metrics", "model_mfu", here).read(record)
