"""Model stack on ``torch``: parameter definitions, the dense layers and the
decoder LM of the dense and vlm families."""
