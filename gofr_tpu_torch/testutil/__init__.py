"""Test utilities of the port: ``redisfake.FakeRedisServer``, an
in-process RESP2 server for the kv-cache's shared tier."""
