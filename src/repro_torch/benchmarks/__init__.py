"""The port's benchmarks: the paper's tables on the card (``run``)."""
