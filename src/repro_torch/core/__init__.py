"""The port's compiler core, module for module beside ``repro/core``.

The planner modules (``span``, ``schedule``, ``latency``, ``memory``,
``perf_library``, ``tuning``, ``fusion``, ``signature``, ``xla_baseline``)
are copies of the reference's, which reach jax only through ``ir``; they
keep the reference device constants so the port commits the same plans.
``ir``, ``codegen``, ``cuda_build``, ``executor``, ``pipeline``,
``compiler`` and ``interop`` are the port's own.
"""
from .compiler import CompiledModule, CompileStats, StitchOptions, compile_module
from .codegen import KernelProgram, StitchedKernel, emit_fusion, emit_stitched_fusion
from .executor import ExecutionPlan, StitchedExecutable, reference_execute
from .fusion import FusedComputation, FusionConfig, FusionPlan, deep_fuse
from .interop import module_from_reference
from .ir import GraphBuilder, Instruction, Module, Tensor, apply_op, torch_dtype, trace
from .pipeline import (
    CodegenPass,
    CompilationState,
    FinalizePass,
    FusionPass,
    MemoryPass,
    PassPipeline,
    SchedulePass,
    default_pipeline,
)
from .schedule import REPLICATED, Sched, ScheduleSolution, StitchedSolution
from .signature import CacheEntry, KernelCache, fusion_signature
from .xla_baseline import xla_baseline_kernel_count
