"""Device inventory of the port: :mod:`.chip` (the record) and
:mod:`.discovery` (CUDA devices, or a fake fleet for tests)."""
