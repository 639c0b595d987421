"""Node actuation of the port: requirement records → per-device client
files → process lifecycle (:mod:`.configd`, :mod:`.files`,
:mod:`.launcherd`), and the control-plane address file
(:mod:`.queryip`)."""
