"""Platform routing, the compile cache's environment handling and
chip_smoke.py's result line and no-GPU exit."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from hala_tpu.error import HalaRendererError
from hala_tpu.models.integrator import (
    RenderSettings,
    _backend,
    auto_intersector,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestAutoIntersector:
    @pytest.mark.parametrize(
        "platform,engine", [("gpu", "pallas"), ("cpu", "bruteforce")]
    )
    def test_supported_platforms(self, platform, engine):
        assert auto_intersector(platform) == engine

    @pytest.mark.parametrize("platform", ["metal", "neuron", "unknown"])
    def test_other_platforms_raise(self, platform):
        with pytest.raises(HalaRendererError):
            auto_intersector(platform)

    def test_auto_on_this_cpu(self, cornell_device_scene):
        s = RenderSettings(width=8, height=8)
        assert _backend(s, cornell_device_scene) == "bruteforce"

    @pytest.mark.parametrize("engine", ["pallas", "bruteforce", "bvh"])
    def test_explicit_choice_kept(self, engine, cornell_device_scene):
        assert cornell_device_scene.bvh is not None
        s = RenderSettings(width=8, height=8, intersector=engine)
        assert _backend(s, cornell_device_scene) == engine

    @pytest.mark.parametrize("axis", [None, "tiles"])
    def test_bvh_without_table_or_sharded(self, axis, cornell_device_scene):
        """bvh falls back to the brute force without a node table, and
        under geometry sharding (the table holds global slot ids)."""
        s = RenderSettings(width=8, height=8, intersector="bvh",
                           scene_axis=axis)
        scene = (
            cornell_device_scene if axis
            else SimpleNamespace(bvh=None, geometry=None)
        )
        assert _backend(s, scene) == "bruteforce"

    @pytest.mark.parametrize("engine", ["matrix", "wavefront", "legacy"])
    def test_removed_engines_rejected(self, engine, cornell_device_scene):
        s = RenderSettings(width=8, height=8, intersector=engine)
        with pytest.raises(ValueError):
            _backend(s, cornell_device_scene)


class TestCompileCache:
    def test_env_var_wins_and_sets_nothing(self, monkeypatch, tmp_path):
        from hala_tpu.utils import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
        used = compile_cache.enable_compilation_cache(str(tmp_path / "own"))
        assert used == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / "own").exists()

    def test_default_dir_without_env(self, monkeypatch, tmp_path):
        from hala_tpu.utils import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        try:
            used = compile_cache.enable_compilation_cache(str(tmp_path))
            assert used == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_dir_is_in_the_checkout(self):
        from hala_tpu.utils.compile_cache import DEFAULT_CACHE_DIR

        assert DEFAULT_CACHE_DIR == os.path.join(ROOT, "out", "xla_cache")


class TestChipSmoke:
    @pytest.mark.parametrize("count", [1, 4])
    def test_result_line(self, count):
        sys.path.insert(0, ROOT)
        import chip_smoke

        dev = SimpleNamespace(platform="gpu",
                              device_kind="NVIDIA H100 80GB HBM3")
        line = chip_smoke.result_line([dev] * count)
        assert json.loads(line) == {
            "ok": True,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": count},
        }

    @staticmethod
    def _run(cwd, *args):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
            capture_output=True, text=True, timeout=300, cwd=cwd, env=env,
        )

    @pytest.mark.parametrize("args", [(), ("--four",)])
    def test_no_gpu_exits_without_result(self, args):
        out = self._run(ROOT, *args)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

    def test_alone_in_a_directory_fails(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = self._run(str(tmp_path))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
