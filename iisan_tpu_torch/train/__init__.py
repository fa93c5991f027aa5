"""Training: loss, optimizer, epoch loop and the cached trainer."""
