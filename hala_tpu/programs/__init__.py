"""Program façade: data-driven pipeline construction.

Parity: reference src/{compute,raytracing,graphics}_program.rs and
src/shader_cache.rs (SURVEY.md section 2.10). In the reference, apps
describe pipelines with serde-JSON descs pointing at SPIR-V files;
here "shaders" are Python kernel functions registered in a process-wide
KernelCache and "pipelines" are jitted executables. The descs keep the
same JSON shape so app-side configs translate directly.
"""

from .shader_cache import KernelCache
from .compute_program import ComputeProgram, ComputeProgramDesc
from .raytracing_program import RayTracingProgram, RayTracingProgramDesc
from .graphics_program import GraphicsProgram, GraphicsProgramDesc

__all__ = [
    "KernelCache",
    "ComputeProgram", "ComputeProgramDesc",
    "RayTracingProgram", "RayTracingProgramDesc",
    "GraphicsProgram", "GraphicsProgramDesc",
]
