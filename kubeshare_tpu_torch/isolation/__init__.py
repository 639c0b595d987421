"""Isolation runtime of the port: the device-owning chip proxy, its
client, the per-device token scheduler and the framed wire."""
