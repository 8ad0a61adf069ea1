"""Token-budget pool routing, host side: categories, pools, the EMA
calibrator and Algorithm 1's router."""
