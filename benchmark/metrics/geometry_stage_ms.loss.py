"""geometry_stage_ms.loss: device ms of the step's "loss" stage, from the
previous on_stage mark to its own (CUDA events), mean per step."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, "loss")
