"""Device topology of the port: :mod:`.chip` (the record),
:mod:`.discovery` (CUDA devices, or a fake fleet for tests),
:mod:`.cellconfig` and :mod:`.cell` (the cell trees the scheduler books
on) and :mod:`.distance` (locality)."""
