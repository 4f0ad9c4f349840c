"""The evaluator's data: ground-truth CSVs, loaders, node features and census tables."""
