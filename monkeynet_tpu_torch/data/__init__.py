"""Host data path: video decode, augmentation, datasets, the threaded loader
and the feeder that stages batches on the card."""
