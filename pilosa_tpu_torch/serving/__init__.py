"""The serving path's result cache (``rescache``); multi-process serving
is not ported yet."""
