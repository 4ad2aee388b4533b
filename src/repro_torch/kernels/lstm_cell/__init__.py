from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused  # noqa: F401
