"""The frozen yardstick: inputs from the seed, work counts, peaks, ESS and the
reading of a profiler trace.  Nothing here imports the port."""
