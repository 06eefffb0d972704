"""The port's invariant gate: static checks and value proofs of the
determinism and precision contracts, the counterpart of the reference's
``repro/analysis`` (which stays the reference's own).  No module here
imports jax or the reference package.

* ``rules.py`` + ``lint.py`` -- torchlint, ``python -m
  repro_torch.analysis.lint src/repro_torch tests chip_smoke.py``: the
  rule registry over the Python sources (``ast``) and the CUDA sources,
  the ``# torchlint: disable=RULE <reason>`` directive (``//`` in CUDA;
  inventoried, never hidden; the reference's permlint does not read it),
  the orphan-module inventory.
* ``geometry.py`` -- ``validate_tiling`` and the geometry auditor
  (``--check``): shared memory and registers, step coverage, a host
  replay of ``run_campaign``, tuning tables, routes, meta shapes.
* ``contracts.py`` + ``prove.py`` -- torchprove (``--check``,
  ``--bless``): every entry at every precision under an op recorder,
  the value goldens in ``tests/torch_goldens/``, and the mesh entries
  under a collective recorder (PT104).
* ``check.py`` -- ``python -m repro_torch.analysis.check``: the three in
  order, exiting with the worst status.

Rule catalog: each rule, its reference counterpart, and the postmortem
behind it (``docs/INVARIANTS.md`` tells the reference's side).

=======  =========  ======================================================
Rule     Reference  Postmortem
=======  =========  ======================================================
PT001    PL001      raw reductions reassociate per program shape: bitwise
                    mesh identity broke (reference PR 3); on the port the
                    library also picks its order per device
PT002    PL002      vmap fused across the batch axis and moved complex
                    values by ulps between batch extents (reference PR 4)
PT003    PL003      tiny-n fallbacks dropped ``precision``/``num_chunks``
                    (reference PRs 5-6); the port guards ``device`` and
                    ``geometry`` too, each of which picks another program
PT004    PL004      wall clocks in core/serve made deadlines untestable
                    (reference PR 7)
PT005    PL005      a config field outside the plan fingerprint split or
                    merged plans silently (reference PR 2)
PT006    PL006      kernel and engine values shared a cache entry
                    (reference PRs 5 and 9: backend, dtype, geometry)
PT007    PL007      a hand-edited tuning table could carry a geometry past
                    the limits (reference PR 9); in the geometry auditor
PT008    (none)     the port stands alone: no jax, no ``repro`` import
                    (the static twin of ``test_torch_isolation.py``)
PTF01    PLF01      unused imports (hygiene)
PTE901   PLE901     a file that does not parse (hygiene)
PC001    PL001      an atomic's order is the scheduler's: sums would vary
                    from run to run
PC002    PL001      a shuffle or ``cub::`` reduction fixes no order the
                    plain versions can repeat
PC003    PLI102     ``fma`` rounds once where the plain version rounds
                    twice; the port's ``fma_rn`` sites are exact products
                    (by 0, 1, -1 or -2), each suppressed with that reason
PC004    PLI102     without ``--fmad=false`` nvcc contracts ``a*b + c``
                    and TwoProd stops being error-free (port PR 11)
PT101    PLI101     a reduction over the batch axis (reference PR 3's
                    class, seen in what ran)
PT102    PLI102     a narrowing cast on an f64/c128 path (the f32 fault
                    repaired in port PRs 17-18 returned f64 the other way)
PT103    PLI103     values drifted with the batch extent (reference PR 4);
                    held here on values and on the op trace, and on a
                    second run
PT104    PLI104     an extra or order-free collective (a psum, an
                    ``all_reduce``) changes the cross-device order; the
                    port's mesh functions gather and reduce in slice-id
                    or bucket order, held on the ``torch.distributed``
                    calls each mesh entry made
=======  =========  ======================================================
"""

from .rules import RULES, Finding, Rule  # noqa: F401

__all__ = ["RULES", "Finding", "Rule"]
