"""Dense decoder-only models: layers, GQA attention, the LM stack, the zoo."""
