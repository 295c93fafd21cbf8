"""repro_torch.train — inputs and train steps, GNN family (twin of
``repro.train``)."""
