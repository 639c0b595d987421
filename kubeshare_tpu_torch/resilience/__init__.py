"""Resilience of the port's isolation runtime (counterpart of
``kubeshare_tpu/resilience``):

- :mod:`.faults` — deterministic, seedable fault injection (the one
  submodule the transport imports; it imports nothing of ``isolation``);
- :mod:`.reconnect` — client-side reconnect-and-replay
  (:class:`~.reconnect.ResilientConnection`), and the budget and backoff
  the pod manager's re-dial uses;
- :mod:`.journal` — the proxy's on-disk session journal;
- :mod:`.migrate` — live migration of a session between proxies.
"""
