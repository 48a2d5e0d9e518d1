"""Datasets and partitioners (numpy; copies of ``repro.data``)."""
