"""Resilience of the port's isolation runtime: what the pod manager's
break-and-reconnect needs (``reconnect.py``)."""
