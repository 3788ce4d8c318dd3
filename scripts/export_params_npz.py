#!/usr/bin/env python
"""Export the parameters of an orbax checkpoint as an .npz that the PyTorch
package (dan_tpu_torch, which does not read orbax) loads:

    python scripts/export_params_npz.py --ckpt /path/orbax_dir --out params.npz
    python -c "from dan_tpu_torch.api import Detector; Detector.from_checkpoint('params.npz')"

--ckpt is what dan_tpu.ckpt.orbax_io.restore_params takes: a save_params
directory, a train model_dir (its newest step) or one step directory.  The
.npz holds one array per "<group>/<layer>/<leaf>" key, in the JAX layout
(kernels HWIO); dan_tpu_torch/ckpt/load.py::load_npz reads it.  Run it
where JAX and orbax are installed; it is host work and runs JAX on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="orbax params dir, train model_dir or step dir")
    ap.add_argument("--out", required=True, help="the .npz file to write")
    args = ap.parse_args(argv)
    import jax

    # Host work: the restore runs on the CPU and leaves any accelerator free.
    jax.config.update("jax_platforms", "cpu")

    from dan_tpu.ckpt.orbax_io import restore_params

    params = restore_params(args.ckpt)
    flat = {
        f"{group}/{layer}/{leaf}": np.asarray(value)
        for group, layers in params.items()
        for layer, leaves in layers.items()
        for leaf, value in leaves.items()
    }
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    np.savez(out, **flat)
    print(f"wrote {len(flat)} arrays to {out}")


if __name__ == "__main__":
    main()
