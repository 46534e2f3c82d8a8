"""What stays testable on the CPU of the GPU entry points: `chip_smoke.py`
refuses any backend but the GPU, its verdict line has exactly the
contract's keys, the compile-cache helper places the cache where it
should, and no module carries a kernel or a backend branch for the
accelerator the system was first written for."""
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import jax

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_result_line_keys():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(
        json.dumps(_load_chip_smoke().result_line([Dev(), Dev()]))
    )
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert line["device"] == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 2,
    }


class TestCompileCache:
    def _run(self, monkeypatch, env_value):
        from fem_elastoplasticity_tpu.utils import compile_cache as cc

        if env_value is None:
            monkeypatch.delenv(cc.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(cc.ENV_VAR, env_value)
        before = jax.config.jax_compilation_cache_dir
        try:
            return cc, cc.enable_compile_cache(), (
                jax.config.jax_compilation_cache_dir
            ), before
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_set_is_used_and_nothing_set(self, monkeypatch, tmp_path):
        cc, got, cfg, before = self._run(monkeypatch, str(tmp_path))
        assert got == str(tmp_path)
        assert cfg == before  # JAX reads the variable itself

    def test_env_unset_uses_fixed_repo_dir(self, monkeypatch):
        cc, got, cfg, _ = self._run(monkeypatch, None)
        assert got == cfg == str(REPO / ".jax_cache")
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_no_foreign_kernels_or_backend_branches():
    """No module imports that accelerator's Pallas dialect (the `[t]pu`
    submodule of `jax.experimental.pallas`), compares the backend or
    device kind with its name, or picks Pallas interpret mode."""
    pattern = re.compile(
        r"pallas[.\s]+(import\s+)?[t]pu\b|pl[t]pu"
        r"|(default_backend\(\)|platform|device_kind)\s*[!=]=\s*['\"][t]pu"
        r"|interpret\s*="
    )
    files = [REPO / "chip_smoke.py", REPO / "bench.py"] + sorted(
        p for d in ("fem_elastoplasticity_tpu", "examples")
        for p in (REPO / d).rglob("*.py")
    )
    hits = [
        f"{p.relative_to(REPO)}:{i}"
        for p in files
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert not hits, hits
