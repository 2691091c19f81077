"""Observability of a ceremony run: phase timings and counters."""
