"""BAL: the block pattern of a bundle-adjustment Hessian.

The structure half of `make_random_bal` (baspacho_tpu_torch/bal.py),
frozen here: the same RandomState draws in the same order (the scene's
values are drawn and dropped, so the observations come out the same),
"window" tracks with loop closures. Where `n_obs` asks for more
distinct (point, camera) pairs than those tracks give (a loop closure
can repeat a camera of its point), that many more points, drawn from the
structure seed among those without a loop closure, see one camera more:
the next camera of the same draw of their window. So each of the first
track_len observations stays as make_random_bal makes it, and the
distinct pairs come to n_obs. The Hessian's pattern is the one
`build_ba_optimizer` gives the solver: points first (3 scalars each, a
sparse elimination range), then cameras (9 each), a block for every
observed (point, camera) pair.
"""

from __future__ import annotations

import numpy as np

from .pattern import Pattern, lower_pattern

POINT, CAMERA = 3, 9


def observations(n_cams: int, n_pts: int, track_len: int, seed: int,
                 window: int, loop_frac: float, n_obs: int = 0) -> tuple:
    """(camera, point) of every observation, as make_random_bal's
    track_mode="window" draws them, and the extra ones that bring the
    distinct pairs to `n_obs` (0: none)."""
    rng = np.random.RandomState(seed)
    rng.rand(n_pts, 3)          # points
    rng.randn(n_cams, 3)        # rotations
    rng.randn(n_cams, 3)        # translations
    rng.rand(n_cams)            # focal lengths
    rng.randn(n_cams)           # k1
    rng.randn(n_cams)           # k2
    tl = min(track_len, n_cams)
    w = min(window, n_cams)
    k = min(tl, w)
    base = np.sort(rng.randint(0, max(1, n_cams - w), size=n_pts))
    order = np.argsort(rng.rand(n_pts, w), axis=1)
    offs = order[:, :k]
    seen = base[:, None] + offs
    loop = rng.rand(n_pts) < loop_frac
    nloop = int(loop.sum())
    if nloop:
        lo2 = rng.randint(0, max(1, n_cams - w), size=nloop)
        offs2 = np.argsort(rng.rand(nloop, w), axis=1)[:, :k - k // 2]
        seen[loop, k // 2:] = lo2[:, None] + offs2
    cam, pt = seen.ravel(), np.repeat(np.arange(n_pts), k)
    extra = n_obs and n_obs - len(np.unique(pt * np.int64(n_cams) + cam))
    if extra < 0:
        raise ValueError(f"{n_obs} observations: the tracks give more")
    if extra:
        plain = np.nonzero(~loop)[0]
        if extra > len(plain) or k >= w:
            raise ValueError(f"{n_obs} observations: more than one extra "
                             "camera per point without a loop closure")
        more = np.sort(np.random.default_rng([seed, 1]).choice(
            plain, size=extra, replace=False))
        cam = np.concatenate([cam, base[more] + order[more, k]])
        pt = np.concatenate([pt, more])
    return cam, pt


def pattern(params: dict) -> Pattern:
    n_cams, n_pts = params["n_cams"], params["n_pts"]
    cam, pt = observations(n_cams, n_pts, params["track_len"],
                           params["seed"], params["window"],
                           params["loop_frac"], params.get("n_obs", 0))
    sizes = np.concatenate([np.full(n_pts, POINT, dtype=np.int64),
                            np.full(n_cams, CAMERA, dtype=np.int64)])
    return lower_pattern(sizes, n_pts + cam, pt, elim_end=n_pts)
