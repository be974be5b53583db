"""Distribution helpers.  Ported: the parameter-spec and init half of
``repro.dist.sharding`` and ``grad_compress`` (the error-feedback int8 and
top-k compressors).  The logical-axis rules, ``pipeline_parallel`` and the
device mesh wait for ROADMAP A.8."""
