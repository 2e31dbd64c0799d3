"""Write bench_ref_f64.npz: float64 solutions of the flagship's first
columns, from the plain numpy reference (tools/np_reference.py).

`chip_smoke.py` and `bench.py` compare the device's solutions of the same
seeded problem (tools/bench_suite.flagship) against it. Runs on the CPU
with numpy alone and never opens an accelerator. Regenerate whenever the
flagship problem changes:

    python tools/gen_bench_ref.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # building the solver touches JAX

N_REF = 4  # columns of the batch to store


def main():
    from tools.bench_suite import flagship

    cfg = flagship()
    x64 = cfg.reference(N_REF)
    out = os.path.join(REPO, "bench_ref_f64.npz")
    # both stored as float32: the problem is f32 data, and rounding the f64
    # solution to f32 is far below any tolerance it is compared with
    np.savez(out, x64=x64.astype(np.float32), b=cfg.B[:, :N_REF],
                        n_ref=N_REF)
    print("wrote", out, x64.shape, file=sys.stderr)


if __name__ == "__main__":
    main()
