"""full_share.dist: of the window's traced K1 and K2 device time, the share
in the kernels instantiated for mode full, in %. A traced name reads
`blend_fwd_kernel<E, MODE, ...>` (or with `_` for the brackets and commas);
MODE indexes ops/blend_visits.py's MODES (K1) or BWD_MODES (K2), and full
is 0 in both. It reads 100 while the depth-distortion machinery runs."""
import re

NAME = re.compile(r"blend_(?:fwd|bwd)_kernel[^0-9-]*-?\d+[^0-9-]+(\d+)")
FULL = 0


def read(rec):
    tr = rec.get("trace")
    full = total = 0.0
    for name, (_, s) in (tr["kernels"] if tr else {}).items():
        m = NAME.search(name)
        if m:
            total += s
            full += s if int(m.group(1)) == FULL else 0.0
    return 100.0 * full / total if total > 0 else None
