"""zstd frame encode of the port: the device v2 encoder's host side."""
