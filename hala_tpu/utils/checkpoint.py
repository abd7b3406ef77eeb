"""Render-state checkpoint / resume.

The reference has only artifact caches (pipeline cache, envmap dist
cache, in-memory shader cache — SURVEY.md section 5.4); its progressive
accumulation image is resumable state that is never persisted. This
module adds the missing capability: the film (accum + AOVs), the frame
index, and the sampler seed round-trip through one .npz, so a
progressive render survives process restarts and chip preemptions (the
elastic-recovery story of SURVEY.md section 5.3).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from ..error import HalaRendererError
from ..models.integrator import Film

_FORMAT_VERSION = 1


def save_render_state(
    path: str, film: Film, frame_index: int, seed: int = 0, extra: dict | None = None
) -> None:
    """Write film + progress to `path` (.npz)."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "accum": np.asarray(film.accum),
        "albedo": np.asarray(film.albedo),
        "normal": np.asarray(film.normal),
        "frame_index": np.int64(frame_index),
        "seed": np.int64(seed),
    }
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_render_state(path: str) -> tuple[Film, int, int, dict]:
    """Read (film, frame_index, seed, extra) back."""
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise HalaRendererError(
                f"Unsupported render-state version {int(z['version'])}."
            )
        film = Film(
            accum=jnp.asarray(z["accum"]),
            albedo=jnp.asarray(z["albedo"]),
            normal=jnp.asarray(z["normal"]),
        )
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        return film, int(z["frame_index"]), int(z["seed"]), extra
