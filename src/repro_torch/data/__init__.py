"""Data of the port: the synthetic token stream and its prefetcher
(``pipeline``)."""
