"""Zero123 score-distillation guidance (port of morpheus_tpu/guidance/)."""
