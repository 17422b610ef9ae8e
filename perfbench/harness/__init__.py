"""The harness: loads a cell by name, runs its set-up and its measured
window, reads the metrics and decides ``correct``."""
