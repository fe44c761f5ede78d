"""Schedule tables and the timestep embedding."""
