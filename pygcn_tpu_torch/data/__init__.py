"""Feature assembly for the evaluator and generator apps (``standardize`` so far)."""
