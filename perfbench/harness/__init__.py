"""The benchmark's own code: lookup by name, traffic, the reading of traces
and containers, the roofline's counts and the comparison that decides
`correct`. It imports nothing of the program; the drivers and run.py do."""
