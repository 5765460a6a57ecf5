"""Entry points (the torch counterpart of ``repro.launch``): ``serve``,
batched recsys scoring + DPP rerank; ``serve_router`` and
``serve_sharded``; ``train``, fault-tolerant training
(auto-resume, failure injection, async checkpoints, int8 error
feedback) with its ``build_family`` and ``make_step``; and the dry run
(``dryrun``, ``run_dryruns``) of the cells on the production meshes
(``mesh``, ``hostdev``, ``shardings``, ``steps``).
"""
