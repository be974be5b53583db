"""Distribution helpers.  Only the parameter-spec and init half of
``repro.dist.sharding`` is ported; the logical-axis rules wait for
ROADMAP A.10."""
