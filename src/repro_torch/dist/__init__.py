"""Distribution helpers, as in ``repro.dist``: ``sharding`` (parameter
specs and their init, the logical-axis rules tables, ``logical_pspec``,
DTensor ``placements``, ``sharding_ctx``/``shard``, ``tree_shardings`` and
``device_put``), ``grad_compress`` (the error-feedback int8 and top-k
compressors, on whole or ``DTensor`` leaves) and ``pipeline_parallel``
(GPipe over one mesh axis).  With them: ``launch.mesh``, the models'
``shard`` constraints, the tensor- and data-parallel LM train step of
``train.step`` and ``launch.train --mesh``, the dry-runs' rule check, the
data-parallel NTTD epoch (``core.codec``) and elastic checkpoint restore."""
from repro_torch.dist import sharding  # noqa: F401  (the load-bearing module)
