"""hala_tpu — a rendering framework in JAX.

A ground-up re-design of the capabilities of `hala-renderer`
(the reference: a Rust/Vulkan renderer library) in
JAX/XLA/Pallas, running on NVIDIA GPUs:

* the hardware ray-tracing path tracer (reference src/rt_renderer.rs)
  becomes a batched path tracer over SoA triangle buffers, with
  brute-force visibility in a Pallas kernel (replacing TLAS/BLAS
  acceleration structures),
* the rasterization renderer (reference src/rz_renderer.rs) becomes a
  tile-binned software rasterizer with forward and deferred paths,
* the Vulkan device layer (external `hala-gfx` crate) is replaced
  wholesale by the JAX device runtime: buffers are jnp arrays,
  pipelines are jitted functions, the pipeline cache is the XLA
  compilation cache, and multi-device scaling is `shard_map` over a
  `jax.sharding.Mesh` with collectives.

Public surface mirrors the reference prelude (reference src/prelude.rs).
"""

from .error import HalaRendererError
from .scene.bounds import Bounds
from .scene.meshlet import Meshlet, MESHLET_MAX_VERTICES, MESHLET_MAX_PRIMITIVES
from .scene.cpu.scene import Scene
from .scene.cpu.node import Node
from .scene.cpu.mesh import Mesh, Primitive
from .scene.cpu.material import Material, Medium, MaterialType, MediumType
from .scene.cpu.light import Light, LightType
from .scene.cpu.camera import Camera, PerspectiveCamera, OrthographicCamera
from .scene.cpu.prims import ProceduralSphere
from .scene.cpu.image_data import ImageData, ImageFormat
from .scene.loader.gltf_loader import GltfLoader
from .scene.loader.uploader import SceneUploader
from .scene.gpu.scene import DeviceScene
from .envmap import EnvMap
from .models.renderer import RendererInfo, RendererStatistics, BaseRenderer
from .models.rt_renderer import RayTracingRenderer, EnvType
from .models.rz_renderer import RasterizationRenderer
from .programs import (
    KernelCache,
    ComputeProgram, ComputeProgramDesc,
    RayTracingProgram, RayTracingProgramDesc,
    GraphicsProgram, GraphicsProgramDesc,
)

__version__ = "0.1.0"

__all__ = [
    "ProceduralSphere",
    "HalaRendererError",
    "Bounds", "Meshlet", "MESHLET_MAX_VERTICES", "MESHLET_MAX_PRIMITIVES",
    "Scene", "Node", "Mesh", "Primitive",
    "Material", "Medium", "MaterialType", "MediumType",
    "Light", "LightType",
    "Camera", "PerspectiveCamera", "OrthographicCamera",
    "ImageData", "ImageFormat",
    "GltfLoader", "SceneUploader", "DeviceScene", "EnvMap",
    "RendererInfo", "RendererStatistics", "BaseRenderer",
    "RayTracingRenderer", "EnvType", "RasterizationRenderer",
    "KernelCache",
    "ComputeProgram", "ComputeProgramDesc",
    "RayTracingProgram", "RayTracingProgramDesc",
    "GraphicsProgram", "GraphicsProgramDesc",
]
