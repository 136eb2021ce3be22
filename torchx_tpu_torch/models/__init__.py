"""The dense Llama decoder."""
