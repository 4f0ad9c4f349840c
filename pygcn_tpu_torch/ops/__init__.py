"""The sparse engine: SpMM over dense, segment, ELL, hybrid and BCSR layouts."""
