"""The MSM pipeline on the ops layer: geometry, host plumbing, cuZK."""
