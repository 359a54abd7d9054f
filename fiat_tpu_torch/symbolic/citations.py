"""Citation registry (counterpart of ``fiat_tpu/symbolic/citations.py``,
role of FInAT's ``finat/citations.py``): element constructors record the
papers they implement; hooks into petsctools' citation system when it is
installed, otherwise a local set."""

_recorded = set()


def cite(key):
    """Record a citation key for the currently constructed element."""
    _recorded.add(key)
    try:
        import petsctools
        petsctools.cite(key)
    except (ImportError, AttributeError):
        pass


def recorded_citations():
    """The set of citation keys recorded so far in this process."""
    return frozenset(_recorded)


#: key -> human-readable reference for the implemented methods
BIBLIOGRAPHY = {
    "Kirby2010": "Kirby, Singularity-free evaluation of collapsed-coordinate "
                 "orthonormal polynomials, ACM TOMS 2010",
    "Arbogast2017": "Arbogast & Tao, Direct serendipity and mixed finite "
                    "elements on convex quadrilaterals, 2017",
    "Alfeld1984": "Alfeld, A trivariate Clough-Tocher scheme for "
                  "tetrahedral data, CAGD 1984",
    "AlfeldSorokina2016": "Alfeld & Sorokina, Linear differential "
                          "operators on bivariate spline spaces, 2016",
    "Arnold2002": "Arnold & Winther, Mixed finite elements for "
                  "elasticity, Numer. Math. 2002",
    "Arnold2003": "Arnold & Winther, Nonconforming mixed elements for "
                  "elasticity, M3AS 2003",
    "ArnoldQin1992": "Arnold & Qin, Quadratic velocity/linear pressure "
                     "Stokes elements, 1992",
    "BernardiRaugel1985": "Bernardi & Raugel, Analysis of some finite "
                          "elements for the Stokes problem, 1985",
    "BrambleZlamal1970": "Bramble & Zlamal, Triangular elements in the "
                         "finite element method, Math. Comp. 1970",
    "ChristiansenHu2019": "Christiansen & Hu, A finite element method "
                          "for elasticity with weak symmetry, 2019",
    "GuzmanNeilan2018": "Guzman & Neilan, Inf-sup stable finite elements "
                        "on barycentric refinements, Math. Comp. 2018",
    "Gopalakrishnan2024": "Gopalakrishnan, Lederer & Schoberl, mass "
                          "conserving mixed stress formulations, 2024",
    "Hu2015": "Hu & Zhang, A family of conforming mixed finite elements "
              "for linear elasticity on triangles, 2015",
    "MingXu2006": "Ming & Xu, The Morley element for fourth order "
                  "elliptic equations in any dimensions, 2006",
    "Walkington2010": "Walkington, A C1 tetrahedral finite element "
                      "without edge degrees of freedom, SINUM 2014",
    "WuXu2019": "Wu & Xu, Nonconforming finite element spaces for 2m-th "
                "order PDEs on R^n simplicial grids, Math. Comp. 2019",
    "Xie2008": "Xie, Shi & Xu, New mixed elements for plane elasticity, "
               "2008",
    "Chin1999higher": "Chin-Joe-Kong, Mulder & Van Veldhuizen, "
                      "higher-order mass-lumped tetrahedral elements, "
                      "1999",
    "Kirby2018zany": "Kirby, A general approach to transforming finite "
                     "elements, SMAI-JCM 2018",
    "Kirby2019zany": "Kirby & Mitchell, Code generation for generally mapped "
                     "finite elements, ACM TOMS 2019",
    "Ciarlet1972": "Ciarlet & Raviart, General Lagrange and Hermite "
                   "interpolation in R^n, ARMA 1972",
    "Morley1971": "Morley, The constant-moment plate-bending element, "
                  "J. Strain Analysis 1971",
    "Argyris1968": "Argyris, Fried & Scharpf, The TUBA family of plate "
                   "elements, Aero. J. 1968",
    "Bell1969": "Bell, A refined triangular plate bending finite element, "
                "IJNME 1969",
    "Clough1965": "Clough & Tocher, Finite element stiffness matrices, 1965",
    "Groselj2022": "Groselj & Knez, Generalized C1 Clough-Tocher splines, "
                   "CAGD 2022",
    "PowellSabin1977": "Powell & Sabin, Piecewise quadratic approximations "
                       "on triangles, TOMS 1977",
    "ArnoldWinther2002": "Arnold & Winther, Mixed finite elements for "
                         "elasticity, Numer. Math. 2002",
    "ArnoldAwanou2011": "Arnold & Awanou, The serendipity family of finite "
                        "elements, FoCM 2011",
    "Mardal2002": "Mardal, Tai & Winther, A robust finite element method "
                  "for Darcy-Stokes flow, SINUM 2002",
    "GuzmanNeilan2019": "Guzman & Neilan, Inf-sup stable finite elements on "
                        "barycentric refinements, Math. Comp. 2019",
    "Isaac2020": "Isaac, Recursive, parameter-free, explicitly defined "
                 "interpolation nodes for simplices, SISC 2020",
    "Geevers2018": "Geevers, Mulder & van der Vegt, New higher-order "
                   "mass-lumped tetrahedral elements, SISC 2018",
    "ChinJoeKong1999": "Chin-Joe-Kong, Mulder & Van Veldhuizen, Higher-order "
                       "mass-lumped triangular/tetrahedral elements, 1999",
    "Brubeck2022": "Brubeck & Farrell, A scalable and robust vertex-star "
                   "relaxation for high-order FEM, SISC 2022",
}
