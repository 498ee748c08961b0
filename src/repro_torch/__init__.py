"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The same StitchIR, the same pass pipeline and the same planner decisions
as the JAX reference, with the two Pallas code generators rewritten as
CUDA C++ generators (``core/codegen.py``, built by ``core/cuda_build.py``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs its plain PyTorch version.
``stitch`` (``frontend/``) captures a PyTorch function into StitchIR and
compiles it per input signature, as ``repro.stitch`` does a JAX function.
``configs`` and ``models`` hold the architectures and the LM stack (forward,
slot and paged decode) in plain torch ops.
The package imports torch and numpy, never jax and nothing of ``repro``.
"""
from .core import (  # noqa: F401
    CompiledModule,
    CompileStats,
    GraphBuilder,
    Module,
    StitchOptions,
    compile_module,
    reference_execute,
)
from . import configs, models  # noqa: F401
from .frontend import (  # noqa: F401
    SUPPORTED_OPS,
    CostEstimate,
    Lowered,
    StitchedFunction,
    UnsupportedPrimitiveError,
    lower_graph,
    stitch,
)
