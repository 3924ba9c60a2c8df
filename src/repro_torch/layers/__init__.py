"""Float boundary layers: bf16 embedding lookup and LM head."""
