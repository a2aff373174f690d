"""How the program is called, one module per configuration `entry`."""
