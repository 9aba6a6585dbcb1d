"""Fault injection for tests and the chip smoke run (the disk plane)."""
