"""The benchmark's yardstick: finding cells, configurations, traffic mixes,
metrics and rooflines by name, the window's arithmetic, the reading of the
device trace, the spans, and the comparison that decides ``correct``."""
