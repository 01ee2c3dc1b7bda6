"""Update rules of the reference's optimizer chain, one module per recipe
`optimizer` name, each with a `Rule(params, recipe)` whose
`direction(grads, count)` gives the step before the learning rate."""
