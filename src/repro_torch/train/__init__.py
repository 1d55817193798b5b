"""Training: AdamW, the train state, the step and the checkpointed loop."""
