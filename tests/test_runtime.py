"""Process set-up: the compile-cache location, protobuf staying off the
main path, and chip_smoke.py refusing to run without a GPU."""

import os
import subprocess
import sys

import pytest

from pcseg_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, **env):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=REPO, env=full_env, capture_output=True,
                          text=True, timeout=300)


def test_compile_cache_honours_environment():
    env = {runtime.CACHE_ENV: "/some/shared/cache"}
    assert runtime.compile_cache_dir(env) == "/some/shared/cache"


def test_compile_cache_defaults_to_checkout():
    assert runtime.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert runtime.compile_cache_dir({runtime.CACHE_ENV: ""}) == \
        os.path.join(REPO, ".jax_cache")


def test_card_line_fails_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        runtime.card_line()


def test_card_line_needs_name_and_power_limit(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="power limit"):
        runtime.card_line()
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    assert runtime.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_device_record_has_no_card_off_the_gpu():
    assert runtime.device_record()["card"] is None


def test_room_stream_batch_shapes():
    frames, (depth, rays, origin, scale) = runtime.room_stream_batch(2, 8, 12)
    assert len(frames) == 2 and depth.shape == (2, 8, 12)
    assert str(depth.dtype) == "uint16" and rays.shape == (8, 12, 3)
    assert origin.shape == (3,) and scale > 0


def test_pipeline_imports_without_protobuf():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[:2] == ['google', 'protobuf']:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from pcseg_tpu import Segmenter\n"
        "from pcseg_tpu.models import pipeline, unorganized\n"
        "Segmenter()\n"
        "assert not [m for m in sys.modules\n"
        "            if m.startswith('google.protobuf')]\n"
        "print('imported')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


def test_chip_smoke_refuses_cpu():
    out = _run([sys.executable, "chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr
