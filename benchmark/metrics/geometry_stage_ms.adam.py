"""geometry_stage_ms.adam: device ms of the step's "adam" stage, from the
previous on_stage mark to its own (CUDA events), mean per step."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, "adam")
