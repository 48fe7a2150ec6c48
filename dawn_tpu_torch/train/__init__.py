"""DM training: augmentation, the chunked-npy data reader and DMTrainer."""
