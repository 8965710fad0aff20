"""Restore-path telemetry of the port: the consume micro-profile."""
