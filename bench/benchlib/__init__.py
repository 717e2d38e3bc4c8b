"""The benchmark's own code: manifest, traffic, work counts, tracing, and
the comparison that decides ``correct``. Nothing here is part of the
program; the program (``src/repro_torch``) is imported only where a cell
is run, inside the functions that run it."""
