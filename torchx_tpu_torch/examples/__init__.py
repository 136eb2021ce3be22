"""The Llama trainer and its token input pipeline."""
