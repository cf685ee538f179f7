"""Step functions and the training and serving drivers of the port."""
