"""The comparison that decides `correct`.

What is judged is the program's own output: the images on the host that
the window's passes produced. The passes checked are the first of the
window, one drawn from the seed among the next 63 (`mid_pass`, where the
window runs that far), and the last; the pixels checked are drawn from the
seed, half of them among pixels whose first primary ray hits a triangle
(where the scene has any), so the closest hit on the mesh is always
covered. The reference computes every sample of those pixels that the
checked passes hold and resolves them as the program does (the mean,
clamped to [0, 1]).

Numbers compared, each the largest over the checked passes:
- gap_mean: the mean absolute gap over the checked pixels' channels;
- off_share: the share of checked channels off by more than OFF.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import reference

OFF = 1e-2
CANDIDATES = 4096


def mid_pass(seed: int) -> int:
    """The index of the window's pass checked beside its first and last."""
    return 1 + int(np.random.default_rng([seed % 2**64, 1]).integers(0, 63))


def checked_pixels(geo, basis, width: int, height: int, seed: int, count: int):
    """`count` distinct pixel ids (int64 numpy) drawn from the seed."""
    g = np.random.default_rng([seed % 2**64, 2])
    n = width * height
    cand = g.choice(n, size=min(CANDIDATES, n), replace=False)
    if geo.n_clusters:
        pix = torch.as_tensor(cand, dtype=torch.int64, device=geo.device)
        o, d = reference.primary_rays(basis.to(geo.device, geo.dtype), width, height,
                                      seed, pix, torch.zeros_like(pix))
        _, prim = geo.closest_hit(o, d)
        on_mesh = geo.is_sphere.new_zeros(prim.shape, dtype=torch.bool)
        hit = prim >= 0
        on_mesh[hit] = ~geo.is_sphere[prim[hit]]
        on_mesh = on_mesh.cpu().numpy()
    else:
        on_mesh = np.zeros(cand.size, bool)
    mesh, other = cand[on_mesh], cand[~on_mesh]
    k = min(count // 2, mesh.size)
    return np.concatenate([mesh[:k], other[:count - k]]).astype(np.int64)


def reference_images(geo, basis, width: int, height: int, render: dict, seed: int,
                     pixels: np.ndarray, sample_counts: list[int],
                     lanes: int = 1 << 17) -> dict:
    """{S: float64 (P, 3) clamped mean of samples 0 .. S - 1} of `pixels`
    for each S of `sample_counts`, by the reference in blocks of at most
    `lanes` paths; `render` holds max_depth and the estimator's options."""
    pix = torch.as_tensor(pixels, dtype=torch.int64)
    p = pix.numel()
    per = max(1, lanes // p)
    total = np.zeros((p, 3), np.float64)
    out, done = {}, 0
    for s_end in sorted(set(sample_counts)):
        while done < s_end:
            k = min(per, s_end - done)
            samples = torch.arange(done, done + k, dtype=torch.int64)
            lane_pix = pix.repeat_interleave(k)
            lane_smp = samples.repeat(p)
            rad = reference.radiance(geo, basis, width, height, seed, lane_pix,
                                     lane_smp, render)
            total += rad.double().reshape(p, k, 3).sum(1).cpu().numpy()
            done += k
        out[s_end] = np.clip(total / s_end, 0.0, 1.0)
    return out


def numbers(program: dict, ref: dict) -> dict:
    """The compared numbers of {S: (P, 3) image} against the reference's
    images of the same sample counts: each the largest over S; None (no
    number, not correct) where an image holds a value that is not finite."""
    gap_mean, off = 0.0, 0.0
    for s, img in program.items():
        diff = np.abs(np.asarray(img, np.float64) - ref[s])
        if not np.all(np.isfinite(diff)):
            return {"gap_mean": None, "off_share": None}
        gap_mean = max(gap_mean, float(diff.mean()))
        off = max(off, float((diff > OFF).mean()))
    return {"gap_mean": gap_mean, "off_share": off}
