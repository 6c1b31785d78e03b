"""The paper's figures and Table I, one module per figure: the reference's
`benchmarks/` figure modules (`python -m repro_torch.figures.run`)."""
