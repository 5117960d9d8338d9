"""What the port needs of preprocessing so far: the character span -> token
span conversion that raw-text serving shares with the prepare stage."""
