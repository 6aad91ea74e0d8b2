"""The framed-message codec (codec.py). The TCP bus comes with the
network slice."""
