"""The training path: optimizer, train and eval steps, LRP-inference
fine-tuning and checkpoints."""
