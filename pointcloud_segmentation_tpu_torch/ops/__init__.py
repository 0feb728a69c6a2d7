"""Device ops of the PyTorch port: preprocessing, Hough extraction, voting."""
