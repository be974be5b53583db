"""Distribution helpers.  Ported: ``sharding`` (parameter specs and their
init, the logical-axis rules tables, ``logical_pspec``, DTensor
``placements``, ``sharding_ctx``/``shard`` and ``tree_shardings``) and
``grad_compress`` (the error-feedback int8 and top-k compressors); with
them ``launch.mesh``, the sharding trees of ``train.step``, the dry-runs'
rule check, the data-parallel NTTD epoch (``core.codec``) and elastic
checkpoint restore.  ``pipeline_parallel`` (GPipe), the models' ``shard``
constraints and the tensor-parallel LM train step wait for ROADMAP A.9."""
