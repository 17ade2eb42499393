"""Checkpoint/resume for progressive renders.

Port of `metalpathtracer_tpu/io/checkpoint.py`, in the same npz format, so
a checkpoint of either package loads in the other: `format_version`,
`rgb_sum` float32 (H, W, 3), `spp` int32 scalar, `seed` uint32, and the
run's fingerprint as `meta_*` entries. Resume continues at the next sample
counter and, with the same samples per pass, adds bit for bit what an
uninterrupted render adds (the RNG is counter-based).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from metalpathtracer_torch.render.pipeline import AccumState

FORMAT_VERSION = 1


def save_checkpoint(path: str, state: AccumState, seed: int,
                    meta: dict | None = None) -> None:
    """Write the state to `path`; reading `rgb_sum` waits for the device."""
    payload = {
        "format_version": FORMAT_VERSION,
        "rgb_sum": state.rgb_sum.cpu().numpy(),
        "spp": np.asarray(state.spp, np.int32),
        "seed": np.uint32(seed & 0xFFFFFFFF),
    }
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"  # .npz suffix keeps savez from appending its own
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)  # atomic: resume never sees a half-written file


def load_checkpoint(path: str, device):
    """Returns (AccumState on `device`, seed, meta_dict)."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint {path} has newer format {version}")
        state = AccumState(
            rgb_sum=torch.as_tensor(z["rgb_sum"].astype(np.float32),
                                    device=device),
            spp=int(z["spp"]),
        )
        seed = int(z["seed"])
        meta = {
            k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
        }
    return state, seed, meta
