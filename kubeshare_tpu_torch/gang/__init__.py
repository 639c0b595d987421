"""Gang helpers of the port: :mod:`.carve`, the ``chip@x.y`` form of a
binding's device list. The gang token coordinator is not ported yet."""
