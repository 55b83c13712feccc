"""The native symbolic library: one build, shared by the port and the
JAX package, and never a silent fallback.

- Processes that start together race the port's loader
  (baspacho_tpu_torch/native.py) on a fresh copy of native/: every one
  loads the same complete library (the build holds a lock and renames a
  finished file into place).
- A JAX loader that cached a miss (it read a half-written library in a
  run of such processes) is re-armed by the tests' shared step
  (same_native.py), after which both packages build the same permutation
  of the spring chain; with the miss left in place they do not.
- With no compiler on PATH, or native/ read-only, the port's loader
  warns with the cause and falls back.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import baspacho_tpu as J
import baspacho_tpu.optimizer as JO
import baspacho_tpu_torch as T
import baspacho_tpu_torch.optimizer as TO
from baspacho_tpu import native as jax_native
from baspacho_tpu_torch import native as port_native
from baspacho_tpu_torch.testing.problems import spring_chain
from same_native import one_native_library, same_native_library  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RACERS = 12


def _fresh_copy(root) -> str:
    """The port's loader and native/'s source, laid out as in the repo
    under root (no library built); returns the loader's path."""
    pkg, nat = root / "pkg", root / "native"
    pkg.mkdir()
    nat.mkdir()
    shutil.copy(port_native.__file__, pkg / "native.py")
    shutil.copy(os.path.join(REPO, "native", "symbolic.cpp"), nat)
    return str(pkg / "native.py")


_RACER = textwrap.dedent("""
    import importlib.util, sys
    spec = importlib.util.spec_from_file_location("racer", sys.argv[1])
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    ok = m.available()
    # the file this process mapped: its inode, from /proc/self/maps
    ino = [ln.split()[4] for ln in open("/proc/self/maps")
           if ln.rstrip().endswith(m.LIB_NAME)]
    print(ok, sorted(set(ino)))
""")


def test_racing_loaders_load_one_library(tmp_path):
    loader = _fresh_copy(tmp_path)
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, loader],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(RACERS)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o.strip() for o, _ in outs}
    so = tmp_path / "native" / port_native.LIB_NAME
    want = f"True ['{os.stat(so).st_ino}']"
    assert lines == {want}, outs
    # nothing half-built is left beside it
    left = sorted(os.listdir(tmp_path / "native"))
    assert left == sorted(["symbolic.cpp", port_native.LIB_NAME,
                           port_native.LOCK_NAME]), left


def _perm(O, pkg, **kw):
    opt = spring_chain(O, n=6, seed=3, **kw)[0]
    opt.build_solver(O.OptimizerSettings(backend=pkg.BackendType.PLANNED))
    return opt.solver.permutation.tolist()


def test_jax_loader_miss_is_rearmed():
    assert port_native.available(), "the port's native library must load"
    port = _perm(TO, T, device="cpu")
    saved = jax_native._TRIED, jax_native._LIB
    try:
        # a JAX loader that read a half-written file: Python analysis
        jax_native._TRIED, jax_native._LIB = True, None
        assert _perm(JO, J) != port
        assert same_native_library()
        assert jax_native._LIB is not None
        assert _perm(JO, J) == port
    finally:
        if jax_native._LIB is None:
            jax_native._TRIED, jax_native._LIB = saved


def test_loader_warns_without_compiler(tmp_path, monkeypatch):
    import importlib.util
    loader = _fresh_copy(tmp_path)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CXX", raising=False)
    spec = importlib.util.spec_from_file_location("nocxx", loader)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ .*symbolic.cpp"):
        assert not m.available()
    assert not os.path.exists(tmp_path / "native" / m.LIB_NAME)
    assert sorted(os.listdir(tmp_path / "native")) == sorted(
        ["symbolic.cpp", m.LOCK_NAME])


def test_loader_warns_in_read_only_tree(tmp_path, monkeypatch):
    import importlib.util
    loader = _fresh_copy(tmp_path)
    spec = importlib.util.spec_from_file_location("readonly", loader)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)

    def read_only(*a, **kw):
        raise PermissionError(30, "Read-only file system", kw.get("dir"))
    # native/ read-only (chmod does not stop root, who runs some tests)
    monkeypatch.setattr(m.os, "open", read_only)
    monkeypatch.setattr(m.tempfile, "mkstemp", read_only)
    with pytest.warns(RuntimeWarning, match="cannot build .*Read-only"):
        assert not m.available()
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path / "native")) == ["symbolic.cpp"]
