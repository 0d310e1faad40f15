"""setup_s: process start to the first timed iteration (imports, the
kernels' build where the checkout has none, scene, caches, the checked
steps, warm-up), on the host's clock."""


def read(rec):
    return rec["setup_s"]
