"""Device stages of the port: match finder, S2 parse+emit, S2 block encode,
and the zstd v2 encoder (parse, sequence chains, entropy stages)."""
