"""Builtin backends of the port — imported lazily by the registry.

* ``ref``    — the torch row-scan oracle (slow, for validation);
* ``engine`` — the torch anti-diagonal engine;
* ``kernel`` — the CUDA wavefronts (their plain versions on a CPU
  tensor), for queries up to the plan's longest
  (``wavefront.longest_query``: auto-selection passes longer ones to
  the engine); soft-min sdtw specs go through
  ``kernels.backward.sdtw_soft_fused`` so that autograd reaches the fused
  reverse-sweep backward; the families run K7, which has no backward:
  a soft family whose operands need a gradient raises, naming the
  engine;
* ``soft`` — an alias: the engine with ``reduction="softmin"``.

All three run hard- and soft-min sdtw and the families twed / erp /
local; ``ref`` and ``engine`` serve ``start`` for sdtw, twed and erp,
``kernel`` for sdtw only.  ref and engine are differentiable under
soft-min for every family, the kernel for sdtw; each adapter turns its sweep's tuple into an
:class:`~repro_torch.core.result.SDTWResult`.  ``soft_alignment`` is
filled above the sweep (``core.api``), so every backend declares it.
"""

from __future__ import annotations

from repro_torch.backends.registry import (Backend, Capabilities, register,
                                           register_alias)
from repro_torch.core import engine, ref
from repro_torch.core.result import from_sweep
from repro_torch.kernels import backward, family, ops

_ALL = frozenset({"sqeuclidean", "abs", "cosine"})
_FULL = frozenset({"cost", "end", "start", "soft_alignment"})
_ALL_FAMILIES = frozenset({"sdtw", "twed", "erp", "local"})
_GLOBAL_WINDOWS = frozenset({"sdtw", "twed", "erp"})


def _exec_ref(spec, plan):
    return from_sweep(
        ref.sdtw_ref(plan.queries, plan.reference, spec=spec,
                     return_window="start" in plan.outputs), plan.outputs)


def _exec_engine(spec, plan):
    return from_sweep(
        engine.sdtw_engine(plan.queries, plan.reference, spec=spec,
                           return_window="start" in plan.outputs),
        plan.outputs)


def _kernel_longest_query(spec, outputs):
    return ops.wavefront.longest_query(spec,
                                       with_window="start" in outputs)


def _exec_kernel(spec, plan):
    family.refuse_grad(spec, plan.queries, plan.reference)
    if spec.soft and spec.family == "sdtw":
        return from_sweep(
            backward.sdtw_soft_fused(plan.queries, plan.reference,
                                     spec=spec,
                                     segment_width=plan.segment_width,
                                     layouts=plan.layouts),
            plan.outputs)
    return from_sweep(
        ops.sdtw_wavefront(plan.queries, plan.reference,
                           segment_width=plan.segment_width, spec=spec,
                           return_window="start" in plan.outputs),
        plan.outputs)


register(Backend(
    name="ref",
    capabilities=Capabilities(distances=_ALL, outputs=_FULL,
                              families=_ALL_FAMILIES,
                              window_families=_GLOBAL_WINDOWS),
    execute=_exec_ref))

register(Backend(
    name="engine",
    capabilities=Capabilities(distances=_ALL, outputs=_FULL,
                              families=_ALL_FAMILIES,
                              window_families=_GLOBAL_WINDOWS),
    execute=_exec_engine))

# soft == the engine with the reduction forced to soft-min
register_alias("soft", "engine", reduction="softmin")

register(Backend(
    name="kernel",
    capabilities=Capabilities(
        # no cosine: the JAX kernel declines it too
        distances=frozenset(ops.wavefront.KERNEL_DISTANCES),
        outputs=_FULL, families=_ALL_FAMILIES,
        longest_query=_kernel_longest_query),
    execute=_exec_kernel))
