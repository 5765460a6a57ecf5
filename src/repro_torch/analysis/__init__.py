"""Static checks of the port (``python -m repro_torch.analysis``).

Three checker families over one findings/suppression framework, the
counterparts of ``repro.analysis``':

* ``repro_torch.analysis.kernels`` — CUDA launch contracts: every plan
  the tile policy, the cluster layout and K7's launch plan can choose,
  evaluated over its grid (coverage, alignment, shared memory against
  the budget and against the wrappers, cluster sizes, co-residency of
  the cooperative launches), and the persisted autotune cache;
* ``repro_torch.analysis.jitgeo`` — the memoised plan functions' keys
  and the router's and the session's one-launch-geometry proofs;
* ``repro_torch.analysis.tracelint`` — AST lint of the host paths (host
  syncs in the router's pump, CUDA-graph captures, non-static obs hooks,
  dead serving names).

Findings carry rule ids (``repro_torch.analysis.findings.RULES``, each
with the ``repro`` rule it stands for in ``COUNTERPARTS``) anchored to
``path:line`` and are suppressible with
``# repro_torch: ignore[rule-id]``.
"""
from repro_torch.analysis.cli import main, run_analysis
from repro_torch.analysis.findings import COUNTERPARTS, RULES, Finding

__all__ = ["COUNTERPARTS", "Finding", "RULES", "main", "run_analysis"]
