"""Run the construct ladder P5 on the card: the 17 minimal kernels of
csrc/ladder.cu, each one construct of the tile kernels, each held against
its plain version on the JAX tool's operands (tools/mosaic_bisect.py).

    python -m google_nerf_tpu_torch.tools.kernel_ladder

Prints `kN <name>: OK` for a rung that builds, launches and matches its
plain version (exactly, or within rtol 1e-5 for k13, k15 and k16), and
`kN <name>: FAIL <reason>` otherwise.  Exits 1 if any rung fails, and
without a card.
"""
from __future__ import annotations

import argparse
import sys

import torch

from google_nerf_tpu_torch.ops.cuda import ladder


def run_rung(k: int, ops: dict) -> tuple[torch.Tensor, str | None]:
    """Rung k on the card against its plain version: (output, None) if
    it agrees, else (output, the reason).  A failed build or launch
    raises RuntimeError."""
    args = ladder.rung_operands(k, ops)
    got = ladder.rung(k, *args)
    torch.cuda.synchronize()
    return got, ladder.mismatch(k, got, ladder.rung_plain(k, *args))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ladder: no CUDA device; the ladder runs "
                         "only on the card")
    ops = ladder.operands("cuda")
    failed = 0
    for k, (name, _) in ladder.RUNGS.items():
        try:
            _, why = run_rung(k, ops)
        except RuntimeError as e:       # the build or the launch failed
            lines = str(e).splitlines()
            why = next((l for l in lines if "error" in l), lines[0])[:300]
        failed += why is not None
        print(f"{name}: OK" if why is None else f"{name}: FAIL {why}",
              flush=True)
    print(f"LADDER DONE: {len(ladder.RUNGS) - failed} of {len(ladder.RUNGS)}"
          " rungs OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
