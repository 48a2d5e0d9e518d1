"""The paper's Section-V application model (the MLP)."""
