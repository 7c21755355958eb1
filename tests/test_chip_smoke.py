"""CPU checks of what the GPU run relies on: chip_smoke.py's phases at tiny
sizes against their host oracles, its refusal to run without a GPU, the
compile-cache rule, and that no TPU module is ever imported.  The full-size
smoke needs the card: `python chip_smoke.py` there (the `gpu` test below
skips elsewhere)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(code: str, **env):
    """Run python code in a fresh CPU-only process from the repo root; the
    compile-cache variable is passed only where a test sets it."""
    full_env = {k: v for k, v in os.environ.items()
                if k != "JAX_COMPILATION_CACHE_DIR"}
    full_env.update(JAX_PLATFORMS="cpu", **env)
    full_env["PYTHONPATH"] = REPO + os.pathsep + full_env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=full_env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return jax.devices()[0]


def test_phase_field_tiny():
    chip_smoke.phase_field(8)


def test_phase_fft_tiny():
    chip_smoke.phase_fft(6)


def test_phase_msm_tiny():
    chip_smoke.phase_msm(8)


def test_phase_main_tiny():
    """The main path's driver at degree 2^4: the proof verifies and the
    record holds every span."""
    rec, circuit = chip_smoke.phase_main(4)
    assert circuit.degree() == 16
    assert set(rec["warm_phases_s"]) >= {"wire_ldes", "vanishing_poly", "ipa"}
    assert rec["verify_s"] > 0


def test_columns_to_ints_roundtrip():
    import numpy as np

    from plonky_tpu.fields import BLS12_377_BASE as F

    vals = [0, 1, F.p - 1, 123456789 << 200]
    digits = np.stack([F.to_digits(v) for v in vals], axis=-1)
    assert chip_smoke.columns_to_ints(digits) == vals


def test_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert "needs a GPU" in r.stderr


def test_smoke_needs_the_package(tmp_path):
    """Alone in a directory, the script fails before printing a result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    chip_smoke.phase_field(16)
    chip_smoke.phase_fft(16)
    chip_smoke.phase_msm(16)
    chip_smoke.phase_fixtures()


_CACHE_PROBE = """
import json, jax, plonky_tpu
import jax._src.compilation_cache as cc
path = plonky_tpu.enable_compilation_cache()
print(json.dumps({
    "path": path,
    "config": jax.config.jax_compilation_cache_dir,
    "cap": getattr(cc.get_executable_and_time, "_plonky_read_cap", False)}))
"""


def test_cache_defaults_to_checkout():
    r = _run(_CACHE_PROBE)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    want = os.path.join(REPO, ".cache", "jax")
    assert out["path"] == out["config"] == want
    assert out["cap"] is True      # the read cap is a CPU-backend guard


def test_cache_honours_env_dir(tmp_path):
    r = _run(_CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["path"] == out["config"] == str(tmp_path)


def test_cache_read_cap_only_on_cpu():
    """On another backend neither the read cap nor the big-stack compile
    guard is installed."""
    code = ("import jax\njax.default_backend = lambda: 'gpu'\n"
            + _CACHE_PROBE
            + "import jax._src.compiler as comp\n"
              "from plonky_tpu.utils import install_big_stack_compile\n"
              "install_big_stack_compile()\n"
              "assert not getattr(comp.compile_or_get_cached,"
              " '_plonky_big_stack', False)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["cap"] is False


def test_no_tpu_module_imported():
    """A field multiply and a point add import nothing TPU-specific."""
    code = """
import sys, jax, jax.numpy as jnp
from plonky_tpu.curves import TWEEDLEDEE as C, ops as cops
from plonky_tpu.fields import ops as fops
f = C.base
x = jnp.ones((f.n_digits, 256), jnp.int32)
jax.block_until_ready(jax.jit(lambda a, b: fops.mul(f, a, b))(x, x))
jax.block_until_ready(jax.jit(lambda p, q: cops.add(C, p, q))((x, x, x),
                                                               (x, x, x)))
assert "jax.experimental.pallas.tpu" not in sys.modules
print("clean")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("clean")
