"""Background planes over a holder: the integrity scrubber and its pacer."""
