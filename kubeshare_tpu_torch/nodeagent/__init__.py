"""Node actuation of the port: per-device client files → process
lifecycle (:mod:`.files`, :mod:`.launcherd`). The config daemon and the
scheduler-IP query of the JAX package are not ported yet."""
