"""Training of the port: AdamW, the train step, the loop and int8
error-feedback gradient compression (reference ``train/``)."""
