"""Training: optimizer and train state, teacher steps, the loop."""
