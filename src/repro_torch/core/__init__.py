"""The port's compiler core, module for module beside ``repro/core``.

The planner modules (``span``, ``schedule``, ``latency``, ``memory``,
``perf_library``, ``tuning``, ``fusion``, ``signature``, ``xla_baseline``)
are copies of the reference's, which reach jax only through ``ir``; they
keep the reference device constants so the port commits the same plans.
``ir``, ``codegen``, ``cuda_build``, ``executor``, ``pipeline``,
``compiler``, ``measure``, ``verify`` and ``interop`` are the port's own,
and so are ``shard`` (the reference's layouts and their propagation, rule
for rule, with DTensor placements for PartitionSpecs) and ``comm`` (the
collectives over ``torch.distributed``).

``__all__`` holds every name of ``repro.core.__all__``, then the port's own
(the CUDA emitters and their programs, ``interop``, ``SubModulePass``, the
sharding names).
"""
from .compiler import CompiledModule, CompileStats, StitchOptions, compile_module
from .codegen import KernelProgram, StitchedKernel, emit_fusion, emit_stitched_fusion
from .executor import ExecutionPlan, LaunchStats, StitchedExecutable, reference_execute
from .fusion import (
    FusedComputation,
    FusionConfig,
    FusionPlan,
    FusionScorer,
    PlannerStats,
    deep_fuse,
)
from .interop import module_from_reference
from .ir import GraphBuilder, Instruction, Module, Tensor, apply_op, torch_dtype, trace
from .latency import H100, TPU_V5E, DeviceSpec, LatencyModel, instr_flops
from .measure import (
    MeasuredCost,
    MeasuredCostStore,
    device_fingerprint,
    emit_group,
    measure_callable,
    measure_group,
    measure_kernel,
)
from .memory import (
    MemoryInfeasible,
    MemoryPlan,
    StitchedMemoryPlan,
    plan_memory,
    plan_stitched_memory,
)
from .perf_library import CostModel, PerfLibrary, TpuSpec
from .pipeline import (
    AutotunePass,
    CodegenPass,
    CompilationState,
    FinalizePass,
    FusionPass,
    MemoryPass,
    PassPipeline,
    SchedulePass,
    ShardingPass,
    SubModulePass,
    default_pipeline,
)
from .schedule import (
    CONSISTENT,
    INFEASIBLE,
    REPLICATED,
    STITCHABLE,
    Sched,
    ScheduleSolution,
    StitchedSolution,
    StitchVerdict,
    Unsatisfiable,
    blocks_of,
    candidate_schedules,
    chunk_shape,
    propagate,
    resolve_schedules,
    resolve_stitched,
    stitchable,
)
from .shard import (
    MeshShape,
    derive_layouts,
    layout_to_placements,
    mesh_axes_of,
    propagate_layouts,
    spec_to_layout,
)
from .signature import CacheEntry, KernelCache, fusion_signature, module_signature
from .span import compute_spans, critical_path_length, layers
from .tuning import TunedPlan, tune
from .verify import (
    RULES,
    Diagnostic,
    VerificationError,
    resolve_verify_mode,
    verify_execution_plan,
    verify_module,
    verify_shard_attrs,
    verify_state,
)
from .xla_baseline import xla_baseline_groups, xla_baseline_kernel_count

__all__ = [
    # repro.core.__all__, in its order
    "CompiledModule", "CompileStats", "StitchOptions", "compile_module",
    "StitchedExecutable", "ExecutionPlan", "reference_execute",
    "CompilationState", "PassPipeline", "default_pipeline", "FusionPass",
    "SchedulePass", "MemoryPass", "CodegenPass", "AutotunePass", "FinalizePass",
    "MeasuredCost", "MeasuredCostStore", "device_fingerprint",
    "measure_callable", "measure_kernel", "emit_group", "measure_group",
    "KernelCache", "CacheEntry", "fusion_signature", "FusedComputation",
    "FusionConfig", "FusionPlan", "FusionScorer", "PlannerStats", "deep_fuse",
    "DeviceSpec", "LatencyModel", "instr_flops", "GraphBuilder", "Instruction",
    "Module", "Tensor", "apply_op", "trace", "MemoryInfeasible", "MemoryPlan",
    "plan_memory", "StitchedMemoryPlan", "plan_stitched_memory",
    "CostModel", "PerfLibrary", "TPU_V5E", "TpuSpec",
    "REPLICATED", "Sched", "ScheduleSolution", "Unsatisfiable", "blocks_of",
    "CONSISTENT", "STITCHABLE", "INFEASIBLE", "StitchVerdict",
    "StitchedSolution", "resolve_stitched", "stitchable",
    "candidate_schedules", "chunk_shape", "propagate", "resolve_schedules",
    "compute_spans", "critical_path_length", "layers", "TunedPlan", "tune",
    "xla_baseline_groups", "xla_baseline_kernel_count",
    "Diagnostic", "VerificationError", "RULES", "resolve_verify_mode",
    "verify_module", "verify_state", "verify_execution_plan",
    # the port's own
    "H100", "KernelProgram", "StitchedKernel", "emit_fusion", "emit_stitched_fusion",
    "LaunchStats", "module_from_reference", "torch_dtype", "SubModulePass",
    "module_signature", "ShardingPass", "MeshShape", "derive_layouts",
    "layout_to_placements", "mesh_axes_of", "propagate_layouts", "spec_to_layout",
    "verify_shard_attrs",
]
