"""The port's communication layer: so far the int8 wire codec."""
