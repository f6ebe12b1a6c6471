"""The roofline of a step on the card (``analysis``): the card's rates, a
counter of a traced step's flops and bytes, and the three-term model."""
