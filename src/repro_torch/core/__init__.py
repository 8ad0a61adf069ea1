"""Token-budget pool routing: categories, pools, the EMA calibrator (scalar
and batch), Algorithm 1's router (scalar and batch), the adaptive
controller and the closed-form cost model."""
