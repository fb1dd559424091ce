from copula_var_tpu_torch.data.returns import (
    ReturnsData,
    from_csv,
    from_prices,
    from_returns,
    synthetic_dataset,
)

__all__ = ["ReturnsData", "from_csv", "from_prices", "from_returns",
           "synthetic_dataset"]
