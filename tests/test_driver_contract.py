"""The entry-point contracts: bench.py, chip_smoke.py and __graft_entry__.

``bench.py`` and ``chip_smoke.py`` measure the GPU, so off the card each must
refuse to run and print no result. ``__graft_entry__`` provides ``entry()`` (a
jittable single-device forward) and ``dryrun_multichip(n)`` (the full sharded
step on an n-device mesh), pinned here on the fake 8-device CPU mesh.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "gpu" in out.stderr.lower()
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repository.
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_graft_entry_and_multichip_dryrun():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.pop(0)

    import jax

    fn, args = graft.entry()
    shape = jax.eval_shape(fn, *args)
    assert shape.shape[-1] == 4 and shape.dtype.name == "uint8"

    # conftest provides the fake 8-device CPU mesh.
    graft.dryrun_multichip(8)


def test_dryrun_multichip_self_provisions():
    """dryrun_multichip provisions its own fake mesh: run it in a clean
    subprocess with every provisioning variable scrubbed."""
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    out = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('ok')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok" in out.stdout
