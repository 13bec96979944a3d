"""Device stages of the port: match finder, S2 parse+emit, S2 block encode,
the zstd v2 encoder (parse, sequence chains, entropy stages), huff0 batch
encode and chunk decode, and the LZ execute of the decoders."""
