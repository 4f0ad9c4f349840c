"""Graph containers, normalizations and dataset builders."""
