"""Tracing and kernel timing helpers."""
