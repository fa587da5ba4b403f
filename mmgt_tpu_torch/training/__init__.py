"""Training of the port: Stage 1 (SMGA with Adan + EMA), Stage 2 (the video
fine-tune and the image pretrain), and the training CLIs' step loop."""
