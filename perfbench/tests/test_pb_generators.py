"""The frozen generators rebuild the port's problem structures, and the
two configurations give the orders and buffer sizes they state."""

import numpy as np
import pytest

from baspacho_tpu_torch import bal as port_bal
from baspacho_tpu_torch.optimizer.optimizer import OptimizerSettings
from baspacho_tpu_torch.solver import BackendType
from baspacho_tpu_torch.testing.mat_gen import SparseMatGenerator
from baspacho_tpu_torch.testing.utils import columns_to_lower_csr

from perfbench import harness, program
from perfbench.reference import bal, grid


@pytest.mark.parametrize("w,h,fill,dist,seed", [(10, 10, 0.25, 1, 3),
                                                (7, 12, 0.6, 2, 37)])
def test_grid_matches_port(w, h, fill, dist, seed):
    port = SparseMatGenerator.gen_grid(w, h, fill, dist, seed=seed)
    assert grid.grid_columns(w, h, fill, dist, seed) == port.columns
    want = columns_to_lower_csr(port.columns)
    pat = grid.pattern(dict(width=w, height=h, fill=fill,
                            conn_max_dist=dist, block=3, seed=seed))
    np.testing.assert_array_equal(pat.ptrs, want.ptrs)
    np.testing.assert_array_equal(pat.inds, want.inds)


@pytest.mark.parametrize("loop_frac", [0.0, 0.2])
def test_bal_matches_port(loop_frac):
    kw = dict(n_cams=12, n_pts=80, track_len=4, seed=5, window=6,
              loop_frac=loop_frac)
    prob = port_bal.make_random_bal(track_mode="window", **kw)
    cam, pt = bal.observations(**kw)
    np.testing.assert_array_equal(cam, prob.obs_cam)
    np.testing.assert_array_equal(pt, prob.obs_pt)
    opt, _, _ = port_bal.build_ba_optimizer(prob, device="cpu")
    want = opt.build_solver(OptimizerSettings(backend=BackendType.PLANNED))
    got = program.analyse(bal.pattern(kw), "cpu")
    for k in ("span_start", "lump_to_span", "chain_col_ptr",
              "chain_row_span", "chain_data"):
        np.testing.assert_array_equal(getattr(got.skel, k),
                                      getattr(want.skel, k))
    np.testing.assert_array_equal(got.permutation, want.permutation)
    assert got.sparse_elim_ranges == want.sparse_elim_ranges


@pytest.mark.parametrize("extra", [1, 17])
def test_bal_extra_observations(extra):
    """n_obs adds one camera of its own window to that many points
    without a loop closure, keeping every track make_random_bal draws."""
    kw = dict(n_cams=30, n_pts=200, track_len=4, seed=5, window=8,
              loop_frac=0.3)
    prob = port_bal.make_random_bal(track_mode="window", **kw)
    base = len(np.unique(prob.obs_pt * 30 + prob.obs_cam))
    cam, pt = bal.observations(**kw, n_obs=base + extra)
    n = len(prob.obs_cam)
    np.testing.assert_array_equal(cam[:n], prob.obs_cam)
    np.testing.assert_array_equal(pt[:n], prob.obs_pt)
    assert len(np.unique(pt * 30 + cam)) == base + extra
    assert len(cam) == n + extra and len(set(pt[n:].tolist())) == extra
    first = prob.obs_cam.reshape(200, 4).min(1)
    assert np.all(np.abs(cam[n:] - first[pt[n:]]) < 8)
    with pytest.raises(ValueError):
        bal.observations(**kw, n_obs=base - 1)


@pytest.mark.parametrize("name", ["bal-871", "grid-200-b8"])
def test_stated_sizes(name):
    """The solver of the configuration at its full size (analysis only,
    on the CPU) has the order, lumps and buffer its file states."""
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    pat = harness.importlib.import_module(
        f"perfbench.reference.{cfg['generator']}").pattern(cfg["params"])
    sk = program.analyse(pat, "cpu").skel
    assert (sk.order, sk.num_lumps, sk.data_size) == (
        cfg["expect"]["order"], cfg["expect"]["lumps"],
        cfg["expect"]["data_size"])
