"""Test configuration. By default every test runs on the CPU with an
8-device virtual mesh, so the multi-device sharding logic runs without
GPUs (SURVEY.md section 4). With HALA_TEST_ON_GPU=1 the tests run on the
process's default jax platform instead, and the `gpu`-marked tests —
compiled Pallas kernels against their references — run there:

    HALA_TEST_ON_GPU=1 python -m pytest tests/ -m gpu

jax.config.update works as long as no backend has been initialized yet.
"""

import os

import jax

if not os.environ.get("HALA_TEST_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one"
    )


@pytest.fixture()
def gpu():
    """The first GPU, or skip: decided when the test runs, never while
    modules are collected."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs a GPU: HALA_TEST_ON_GPU=1 python -m pytest tests/ -m gpu"
        )
    return device


@pytest.fixture(scope="session")
def cornell_scene():
    from hala_tpu.scene.procedural import cornell_box

    return cornell_box()


@pytest.fixture(scope="session")
def cornell_device_scene(cornell_scene):
    from hala_tpu.scene.loader.uploader import SceneUploader

    return SceneUploader.upload(cornell_scene, use_ray_tracing=True)


@pytest.fixture()
def rs():
    return np.random.RandomState(42)


def make_glass_scene(front_a=None, mid_a=None):
    """Opaque back wall at z=-1; optional transparent full-screen
    quads at z=0 (front_a) and z=-0.5 (mid_a). Single-sided quads
    facing the camera, so each contributes exactly ONE layer. Shared
    by the transparency/blend tests (test_raster, test_programs)."""
    from hala_tpu.scene.cpu.camera import PerspectiveCamera
    from hala_tpu.scene.cpu.light import Light, LightType
    from hala_tpu.scene.cpu.material import Material, MaterialType
    from hala_tpu.scene.cpu.mesh import Mesh
    from hala_tpu.scene.cpu.node import Node
    from hala_tpu.scene.cpu.scene import Scene
    from hala_tpu.scene.procedural import make_quad

    scene = Scene()
    mats = [Material(type=MaterialType.DIFFUSE,
                     base_color=np.array([0.6, 0.2, 0.2], np.float32))]
    prims = [make_quad([-2, -2, -1], [4, 0, 0], [0, 4, 0], 0)]
    for z, a, col in [(-0.5, mid_a, [0.2, 0.6, 0.2]),
                      (0.0, front_a, [0.8, 0.8, 0.9])]:
        if a is None:
            continue
        mats.append(Material(
            type=MaterialType.DIFFUSE,
            base_color=np.array(col, np.float32),
            opacity=np.float32(a),
        ))
        prims.append(
            make_quad([-2, -2, z], [4, 0, 0], [0, 4, 0], len(mats) - 1)
        )
    scene.materials = mats
    scene.meshes = [Mesh(primitives=prims)]
    root = Node(name="root")
    root.mesh_index = 0
    scene.nodes.append(root)
    light_node = Node(name="light")
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0, 0, 2.5]
    light_node.local_transform = m
    light_node.light_index = 0
    scene.nodes.append(light_node)
    scene.lights = [Light(color=np.ones(3, np.float32), intensity=30.0,
                          light_type=LightType.POINT)]
    cam_node = Node(name="camera")
    cm = np.eye(4, dtype=np.float32)
    cm[:3, 3] = [0, 0, 3.0]
    cam_node.local_transform = cm
    cam_node.camera_index = 0
    scene.nodes.append(cam_node)
    scene.cameras = [PerspectiveCamera(aspect=1.0, yfov=0.7, znear=0.1,
                                       focal_distance=3.0)]
    scene.update_node_hierarchies()
    return scene
